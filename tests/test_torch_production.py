"""The estimated-pose mission of otslam_tpu_torch against otslam_tpu on the
cardboard room for 300 ticks (tests/torch_missions.py has the recipe and
the tolerances), and StaticWallFilter's wall mask, which the port computes
without scipy, equal to the JAX package's on three maps."""

import dataclasses

import numpy as np
import pytest

import otslam_tpu.mapping.object_filter as jof
import otslam_tpu.sim.world as jworld
import otslam_tpu_torch.mapping.object_filter as tof
import otslam_tpu_torch.sim.world as tworld
from torch_missions import (JAX, PHANTOM, PORT, assert_missions_match,
                            estimated_pose_mission)


def test_estimated_pose_mission_matches_jax_on_cardboard(tmp_path):
    jr, js = estimated_pose_mission(JAX, "cardboard_room", tmp_path / "jax",
                                    300)
    tr, ts = estimated_pose_mission(PORT, "cardboard_room",
                                    tmp_path / "torch", 300)
    assert_missions_match(jr, js, tmp_path / "jax", tr, ts, tmp_path / "torch")
    # the run exercises every estimated-pose branch: drift, the localizer's
    # corrections, and the removed-object check of the phantom box
    assert ts.missions_completed >= 4 and ts.stable_objects >= 1
    assert "Removed_0" in ts.labels and tr.sender.visited_removed_ids
    assert np.abs(tr._odom_drift).max() > 0
    assert tr.pose_estimate != (tr.x, tr.y, tr.yaw)


@pytest.mark.parametrize("scene", ["cardboard_room", "table_chair_room",
                                   "full_room"])
@pytest.mark.parametrize("phantom", [False, True])
def test_static_wall_mask_equals_jax(scene, phantom):
    """The 4-connected components, their bounding boxes and the cross
    dilation with nothing outside the grid give scipy.ndimage's mask."""
    js, ts = getattr(jworld, scene)(), getattr(tworld, scene)()
    if phantom:
        js = dataclasses.replace(js, objects=(jworld.Box(*PHANTOM),))
        ts = dataclasses.replace(ts, objects=(tworld.Box(*PHANTOM),))
    jm = jof.StaticWallFilter(js.occupancy_grid(0.05))._mask
    tm = tof.StaticWallFilter(ts.occupancy_grid(0.05))._mask
    assert tm.dtype == jm.dtype == bool
    np.testing.assert_array_equal(tm, jm)
    assert 0 < tm.sum() < tm.size


def test_static_wall_filter_helpers_match_scipy():
    """The two replacements on a random grid with wall-sized and small
    components and occupied border cells: the same components as
    ndimage.label, and ndimage.binary_dilation's mask at every depth."""
    from scipy import ndimage
    rng = np.random.default_rng(3)
    occ = rng.random((40, 56)) < 0.45
    occ[0, :] = occ[:, -1] = True
    labels, num = ndimage.label(occ)
    ours = sorted(sorted(zip(r.tolist(), c.tolist()))
                  for r, c in tof._components(occ))
    theirs = sorted(sorted(zip(*np.nonzero(labels == k)))
                    for k in range(1, num + 1))
    assert ours == [[(int(r), int(c)) for r, c in cells] for cells in theirs]
    for it in (1, 2, 6):
        m = occ & (rng.random(occ.shape) < 0.1)
        np.testing.assert_array_equal(tof._dilate_cross(m, it),
                                      ndimage.binary_dilation(
                                          m, iterations=it))
