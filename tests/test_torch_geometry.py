"""PointCloud, back-projection and voxel downsampling of the port against
otslam_tpu (CPU).

Back-projection is one product a coordinate, so it is exact; the world
placement is a 3x3 product and agrees to 1e-6. Voxel downsampling gives
the JAX order (ascending voxel key) and mask exactly; its centroids and
mean colours agree to <= 1e-6, the sums within a voxel being taken in
another order (XLA's unstable sort and segment sum, the port's stable
sort and index_add_).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otslam_tpu.core import pointcloud as jpc
from otslam_tpu.kernels.backproject import \
    backproject_pointcloud as j_backproject
from otslam_tpu.kernels.voxel import voxel_downsample as j_voxel
from otslam_tpu_torch.core import pointcloud as tpc
from otslam_tpu_torch.core.se3 import euler_xyz_to_matrix, se3
from otslam_tpu_torch.kernels.backproject import (backproject_pointcloud,
                                                  filter_depth)
from otslam_tpu_torch.kernels.voxel import voxel_downsample
from torch_parity import J_SMALL, T_SMALL, capture


@pytest.fixture(scope="module")
def frame():
    """One rendered 160x120 frame: depth with NaN/inf/far returns added,
    uint8 colour, camera->world pose."""
    d, c, e = capture(2)
    depth = d[0].copy()
    depth[3, :5] = np.nan
    depth[4, :5] = np.inf
    depth[5, :5] = 7.0
    return depth, c[0].astype(np.uint8), np.linalg.inv(e[0])


def test_pointcloud_matches_jax(rng):
    pts = rng.standard_normal((40, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    jc = jpc.PointCloud.from_numpy(pts, cols, capacity=64)
    tc = tpc.PointCloud.from_numpy(pts, cols, capacity=64, device="cpu")
    assert tc.capacity == 64 and int(tc.count()) == 40
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    for a, b in zip(tc.to_numpy(), jc.to_numpy()):
        np.testing.assert_array_equal(a, b)
    T = se3(euler_xyz_to_matrix(0.1, -0.2, 0.3), [0.5, -1.0, 2.0])
    np.testing.assert_allclose(tc.transformed(T).points.numpy(),
                               np.asarray(jc.transformed(T).points),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.painted((1.0, 0.0, 0.5)).colors.numpy(),
                                  np.asarray(jc.painted((1.0, 0.0, 0.5))
                                             .colors))
    both = tpc.concatenate([tc, tpc.PointCloud(torch.zeros(5, 3))])
    jboth = jpc.concatenate([jc, jpc.PointCloud(jnp.zeros((5, 3)))])
    assert both.colors is None and jboth.colors is None
    np.testing.assert_array_equal(both.valid_mask().numpy(),
                                  np.asarray(jboth.valid_mask()))
    with pytest.raises(ValueError):
        tpc.PointCloud.from_numpy(pts, capacity=10, device="cpu")


def test_filter_depth():
    d = torch.tensor([np.nan, np.inf, -1.0, 0.0, 1.0, 3.0, 3.5])
    np.testing.assert_array_equal(filter_depth(d, 3.0).numpy(),
                                  [0, 0, 0, 0, 1.0, 3.0, 0])


@pytest.mark.parametrize("placed", [False, True])
def test_backproject_matches_jax(frame, placed):
    depth, color, c2w = frame
    ext = c2w if placed else None
    jc = j_backproject(jnp.asarray(depth), jnp.asarray(color), J_SMALL,
                       depth_trunc=5.0,
                       extrinsic_inv=None if ext is None else jnp.asarray(ext))
    tc = backproject_pointcloud(depth, color, T_SMALL, depth_trunc=5.0,
                                extrinsic_inv=ext, device="cpu")
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.colors.numpy(), np.asarray(jc.colors))
    m = tc.mask.numpy()
    assert m.sum() > 1000 and not m.all()
    if placed:
        np.testing.assert_allclose(tc.points.numpy()[m],
                                   np.asarray(jc.points)[m], rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(tc.points.numpy(),
                                      np.asarray(jc.points))


@pytest.mark.parametrize("voxel", [0.01, 0.05])
def test_voxel_downsample_matches_jax(frame, voxel):
    depth, color, c2w = frame
    tc = backproject_pointcloud(depth, color, T_SMALL, depth_trunc=5.0,
                                extrinsic_inv=c2w, device="cpu")
    pts, cols, mask = tc.points, tc.colors, tc.mask
    jp, jcol, jm = j_voxel(jnp.asarray(pts.numpy()), voxel,
                           mask=jnp.asarray(mask.numpy()),
                           colors=jnp.asarray(cols.numpy()))
    tp, tcol, tm = voxel_downsample(pts, voxel, mask=mask, colors=cols)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert 100 < jm.sum() < mask.sum()
    np.testing.assert_allclose(tp.numpy()[jm], np.asarray(jp)[jm], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tcol.numpy()[jm], np.asarray(jcol)[jm],
                               rtol=0, atol=1e-6)


def test_voxel_downsample_without_mask_or_colors(rng):
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    pts[7] = np.nan                              # non-finite rows drop out
    jp, jcol, jm = j_voxel(jnp.asarray(pts), 0.25)
    tp, tcol, tm = voxel_downsample(torch.as_tensor(pts), 0.25)
    assert tcol is None and jcol is None
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tp.numpy()[jm], np.asarray(jp)[jm], rtol=0,
                               atol=1e-6)


def test_probes_match_jax(rng):
    from otslam_tpu.utils import probes as jpr
    from otslam_tpu_torch.utils import probes as tpr
    depth = rng.uniform(0.3, 6.0, (12, 16)).astype(np.float32)
    depth[0, :4] = 0.0
    depth[1, :2] = np.nan
    mm = (np.nan_to_num(depth) * 1000).astype(np.uint16)
    for d in (depth, mm):
        assert tpr.depth_stats(d) == jpr.depth_stats(d)
        np.testing.assert_array_equal(tpr.depth_heat_image(d),
                                      jpr.depth_heat_image(d))
    poses = [np.eye(4), se3(euler_xyz_to_matrix(0.1, 0.2, 0.3), [1, 2, 3])]
    for a, b in zip(tpr.trajectory_frames(poses),
                    jpr.trajectory_frames(poses)):
        np.testing.assert_array_equal(a, b)


def test_stage_timer_labels_the_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    from otslam_tpu_torch.utils.profiling import StageTimer
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with StageTimer() as t:
            for _ in range(2):
                with t.stage("fuse", sync=True):
                    torch.ones(8).sum()
            with t.stage("extract"):
                pass
    assert t.counts == {"fuse": 2, "extract": 1}
    assert t.totals["fuse"] > 0 and t.totals["extract"] >= 0
    names = [e.name for e in prof.events()]
    assert names.count("fuse") == 2 and names.count("extract") == 1
