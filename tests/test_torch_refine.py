"""The port's trajectory refinement against otslam_tpu (CPU): frame
sampling, frame-to-frame ICP, frame-to-model tracking, and the pose graph
with loop closures (the entry points that run them are in
test_torch_refine_entry.py).

Captures are rendered by the JAX package at 160x120 and drifted by
compounding odometry noise (tests/test_refine.py's make_captures and
perturb); both packages get the same numpy arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

from otslam_tpu.core.camera import PinholeIntrinsics as JIntr
from otslam_tpu.pipeline import refine as jr
from otslam_tpu_torch.config import OTSLAMConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.pipeline import refine as tr
from test_refine import CAM, CFG, make_captures, perturb

TCFG = OTSLAMConfig.from_dict(
    {"reconstruction": dataclasses.asdict(CFG)}).reconstruction
J_INTR = JIntr.from_config(CAM)
T_INTR = PinholeIntrinsics.from_config(TCFG.camera)


@pytest.fixture(scope="module")
def drifted():
    depths, colors, gt, _ = make_captures(8)
    return depths, colors, perturb(gt), gt


@pytest.fixture(scope="module")
def looped():
    """10 frames 45 degrees apart around the box: the last two revisit the
    first two views, so the default loop detector (min_gap 8, radius
    0.8 m) finds loop edges. Drifted like `drifted`."""
    from otslam_tpu.sim.sensors import look_at_pose, render_rgbd
    from otslam_tpu.sim.world import cardboard_room
    depths, colors, exts = [], [], []
    for i in range(10):
        a = 2 * np.pi * i / 8 + 0.1
        eye = [1.5 + 1.1 * np.cos(a), 0.5 + 1.1 * np.sin(a), 0.5]
        pose = look_at_pose(eye, np.array([1.5, 0.5, 0.15]))
        d, c = render_rgbd(cardboard_room(), pose, J_INTR, far=5.0)
        depths.append(np.asarray(d))
        colors.append(np.asarray(c))
        exts.append(np.linalg.inv(pose))
    gt = np.stack(exts).astype(np.float32)
    return np.stack(depths), np.stack(colors), perturb(gt, seed=1), gt


class TestFramePointSampling:
    def test_whole_image_support_at_vga(self):
        """_frame_points subsamples uniformly rather than truncating (a
        [:max_points] cut of the row-major VGA grid keeps only the top
        ~43 % of the image)."""
        intr = PinholeIntrinsics(640, 480, 565.6009, 565.6009, 320.5, 240.5)
        depth = torch.full((480, 640), 2.0)
        pts, mask = tr._frame_points(depth, intr, stride=4, max_points=8192)
        assert pts.shape[0] <= 8192
        y = pts[mask][:, 1].numpy()
        assert y.min() < -0.6, f"no top-of-image points (ymin={y.min():.2f})"
        assert y.max() > 0.6, f"no bottom-of-image points (ymax={y.max():.2f})"

    def test_frame_points_and_normals_match_jax(self, drifted):
        depths = drifted[0]
        for stride in (2, 4):
            jp, jm = jr._frame_points(depths[3], J_INTR, stride=stride,
                                      max_points=2000)
            tp, tm = tr._frame_points(torch.from_numpy(depths[3]), T_INTR,
                                      stride=stride, max_points=2000)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                       atol=1e-6)
            jout = jr._frame_points_normals(depths[3], J_INTR, stride)
            tout = tr._frame_points_normals(torch.from_numpy(depths[3]),
                                            T_INTR, stride)
            np.testing.assert_array_equal(tout[2].numpy(),
                                          np.asarray(jout[2]))
            ok = tout[2].numpy()
            assert ok.mean() > 0.3
            for a, b in zip(tout[:2], jout[:2]):
                np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                           rtol=0, atol=1e-6)


REFINERS = {"icp": "refine_trajectory", "f2m": "refine_trajectory_f2m",
            "pgo": "refine_trajectory_pgo"}


def assert_trajectory_error_close(ext_t, ext_j, gt):
    """trajectory_error of the two packages' poses: translation RMSE within
    1e-4 m; rotation RMSE within 1e-3 rad, because arccos of an f32 trace
    resolves sub-milliradian angles only to ~3.5e-4 rad, so one ulp in one
    pose moves it that far."""
    t_t, r_t = tr.trajectory_error(ext_t, gt)
    t_j, r_j = jr.trajectory_error(ext_j, gt)
    assert abs(t_t - t_j) <= 1e-4
    assert abs(r_t - r_j) <= 1e-3


def refine_both(which, depths, colors, noisy):
    jres = getattr(jr, REFINERS[which])(depths, colors, noisy, J_INTR, CFG,
                                        max_active=1024)
    tres = getattr(tr, REFINERS[which])(depths, colors, noisy, T_INTR, TCFG,
                                        max_active=1024, device="cpu")
    return jres, tres


def test_refine_trajectory_icp_matches_jax(drifted):
    """Frame-to-frame ICP: the poses never see the fused volume."""
    depths, colors, noisy, gt = drifted
    jres, tres = refine_both("icp", depths, colors, noisy)
    np.testing.assert_allclose(tres.extrinsics, jres.extrinsics, rtol=0,
                               atol=1e-4)
    assert_trajectory_error_close(tres.extrinsics, jres.extrinsics, gt)
    assert tr.trajectory_error(noisy, gt) == jr.trajectory_error(noisy, gt)
    np.testing.assert_allclose(tres.fitness, jres.fitness, atol=1e-4)
    assert (tr.trajectory_error(tres.extrinsics, gt)[0]
            < tr.trajectory_error(noisy, gt)[0])
    # the final fusion under the same cap: equal off rounding ties
    np.testing.assert_array_equal(tres.volume.created.numpy(),
                                  np.asarray(jres.volume.created))
    w_t, w_j = tres.volume.weight.numpy(), np.asarray(jres.volume.weight)
    assert (w_t != w_j).sum() <= 1e-4 * (w_j > 0).sum()


# Frame-to-model chains (f2m, and pgo on its default f2m front end) are
# held to the reference's own conditioning rather than to 1e-4: each frame
# fuses at its tracked pose, and a pose that moves by ~1e-7 fuses a voxel on
# a .5-pixel rounding tie into the other pixel, which moves the next
# tracked pose. The JAX package itself, with its fusion poses perturbed by
# one ulp, moves by up to 3.2e-4 on `drifted` and 2.4e-3 (f2m) / 1.3e-3
# (pgo) on `looped` (measured). Given the same model the two trackers agree
# to <= 2.4e-7 per frame (test_torch_registration.py holds the tracker).
F2M_ATOL = {"drifted": 1e-3, "looped": 3e-3}


def test_refine_trajectory_f2m_matches_jax(drifted):
    depths, colors, noisy, gt = drifted
    jres, tres = refine_both("f2m", depths, colors, noisy)
    np.testing.assert_allclose(tres.extrinsics, jres.extrinsics, rtol=0,
                               atol=F2M_ATOL["drifted"])
    t_t = tr.trajectory_error(tres.extrinsics, gt)[0]
    assert abs(t_t - jr.trajectory_error(jres.extrinsics, gt)[0]) < 1e-3
    np.testing.assert_allclose(tres.fitness, jres.fitness, atol=1e-2)
    assert t_t < 0.6 * tr.trajectory_error(noisy, gt)[0]


def test_refine_trajectory_pgo_matches_jax(looped):
    """Pose graph over a frame-to-frame ICP chain and the loop edges of the
    revisit (front_end="icp": no pose depends on the fused volume)."""
    depths, colors, noisy, gt = looped
    kw = dict(max_active=1024, front_end="icp")
    jres = jr.refine_trajectory_pgo(depths, colors, noisy, J_INTR, CFG, **kw)
    tres = tr.refine_trajectory_pgo(depths, colors, noisy, T_INTR, TCFG,
                                    device="cpu", **kw)
    np.testing.assert_allclose(tres.extrinsics, jres.extrinsics, rtol=0,
                               atol=1e-4)
    assert_trajectory_error_close(tres.extrinsics, jres.extrinsics, gt)
    t0 = tr.trajectory_error(noisy, gt)[0]
    assert tr.trajectory_error(tres.extrinsics, gt)[0] < 0.6 * t0


def test_refine_trajectory_pgo_f2m_front_end_matches_jax(looped):
    """pgo on its default f2m front end: within the reference's own
    conditioning (F2M_ATOL), and the drift falls as far."""
    depths, colors, noisy, gt = looped
    jres, tres = refine_both("pgo", depths, colors, noisy)
    np.testing.assert_allclose(tres.extrinsics, jres.extrinsics, rtol=0,
                               atol=F2M_ATOL["looped"])
    t_t = tr.trajectory_error(tres.extrinsics, gt)[0]
    assert abs(t_t - jr.trajectory_error(jres.extrinsics, gt)[0]) < 1e-3
    assert t_t < tr.trajectory_error(noisy, gt)[0]


def test_loop_closures_match_jax(looped):
    depths, _, _, gt = looped
    jl = jr.detect_loop_closures(depths, gt, J_INTR)
    tl = tr.detect_loop_closures(depths, gt, T_INTR, device="cpu")
    assert len(tl) == len(jl) >= 1
    for (ti, tj, tM, tf), (ji, jj, jM, jf) in zip(tl, jl):
        assert (ti, tj) == (ji, jj)
        np.testing.assert_allclose(tM, jM, rtol=0, atol=1e-4)
        assert tf == pytest.approx(jf, abs=1e-6)
