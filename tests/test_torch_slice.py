"""The port's first slice end to end against otslam_tpu (CPU).

A capture circle of cardboard_room() is rendered and saved with the JAX
package's CaptureDataset; both packages reconstruct it from disk
(reconstruct_object, same sample draws) and score it (evaluate_map).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from otslam_tpu.config import ReconstructionConfig as JRCfg
from otslam_tpu.config import CameraConfig as JCam
from otslam_tpu.config import TSDFConfig as JTCfg
from otslam_tpu.eval.metrics import evaluate_map as j_evaluate_map
from otslam_tpu.eval.scenarios import scenario_gt as j_scenario_gt
from otslam_tpu.pipeline.dataset import CaptureDataset as JDataset
from otslam_tpu.pipeline.reconstruct import reconstruct_object as j_reconstruct
from otslam_tpu.sim.sensors import look_at_pose
from otslam_tpu.sim.sensors import render_depth as j_render_depth
from otslam_tpu.sim.sensors import render_rgbd as j_render
from otslam_tpu.sim.world import cardboard_room as j_room
from otslam_tpu_torch.config import OTSLAMConfig
from otslam_tpu_torch.core import io as tio
from otslam_tpu_torch.eval.metrics import evaluate_map
from otslam_tpu_torch.eval.scenarios import scenario_gt
from otslam_tpu_torch.kernels.nn import chamfer_metrics
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.pipeline.reconstruct import reconstruct_object
from otslam_tpu_torch.sim import render_depth
from otslam_tpu_torch.sim.sensors import render_rgbd
from otslam_tpu_torch.sim.world import cardboard_room
from torch_parity import BOX_CENTER, J_SMALL, SMALL_CAM, T_SMALL

SAMPLES = 20_000
CAM = dict(SMALL_CAM, depth_trunc=3.0)
VOL = dict(voxel_size=0.02, sdf_trunc=0.08, dims=(64, 64, 64))


def poses(n, radius=1.0, height=0.5):
    c = np.asarray(BOX_CENTER)
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        out.append(look_at_pose([c[0] + radius * np.cos(a),
                                 c[1] + radius * np.sin(a), height], c))
    return out


def test_render_rgbd_matches_jax():
    for pose in poses(6) + [look_at_pose([0.0, 0.0, 1.2], [1.5, 0.5, 0.0])]:
        jd, jc = j_render(j_room(), pose, J_SMALL, far=5.0)
        td, tc = render_rgbd(cardboard_room(), pose, T_SMALL, far=5.0,
                             device="cpu")
        assert (td > 0).float().mean() > 0.5
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        # render_depth is render_rgbd's depth, in both packages
        tdd = render_depth(cardboard_room(), pose, T_SMALL, far=5.0,
                           device="cpu")
        assert torch.equal(tdd, td)
        np.testing.assert_array_equal(
            np.asarray(j_render_depth(j_room(), pose, J_SMALL, far=5.0)),
            np.asarray(jd))
        np.testing.assert_allclose(tdd.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """16 frames saved by the JAX package's scanner-side writer."""
    root = str(tmp_path_factory.mktemp("capture"))
    cam = JCam(**CAM)
    ds = JDataset(root, cam)
    from otslam_tpu.core.se3 import T_FIX_OPTICAL
    for pose in poses(16):
        d, c = j_render(j_room(), pose, J_SMALL, far=cam.depth_max)
        # the dataset stores map->body poses: optical = body @ T_fix
        ds.save_frame("Object_0", np.asarray(c).astype(np.uint8),
                      np.asarray(d), pose @ np.linalg.inv(T_FIX_OPTICAL))
    return root


def jax_draws(seed=0):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                         (SAMPLES,)))


def run_both(root, tmp_path, backend="sparse", frames=None):
    jcfg = JRCfg(surface_samples=SAMPLES, camera=JCam(**CAM),
                 tsdf=JTCfg(**VOL))
    tcfg = OTSLAMConfig.from_dict({"reconstruction": dataclasses.asdict(jcfg)
                                   }).reconstruction
    jres = j_reconstruct(JDataset(root, jcfg.camera), "Object_0", jcfg,
                         backend=backend, save_dir=str(tmp_path / "jax"),
                         auto_origin=True, frame_numbers=frames)
    tres = reconstruct_object(CaptureDataset(root, tcfg.camera), "Object_0",
                              tcfg, backend="pallas",
                              save_dir=str(tmp_path / "torch"),
                              auto_origin=True, frame_numbers=frames,
                              draws=torch.tensor(jax_draws()), device="cpu")
    jp = tio.read_ply(str(tmp_path / "jax" / "Object_0.ply"))["points"]
    tp = tio.read_ply(str(tmp_path / "torch" / "Object_0.ply"))["points"]
    return jres, tres, jp, tp


def test_reconstruct_and_eval_match_jax_sparse(dataset, tmp_path):
    jres, tres, jp, tp = run_both(dataset, tmp_path)
    assert tres.num_frames == jres.num_frames == 16
    assert tres.raw_surface_count == jres.raw_surface_count
    assert len(tp) == len(jp) > 1000
    # points from voxels whose projection sits on a .5 pixel tie (see
    # torch_parity) may move by a small fraction of a voxel
    err = np.abs(tp - jp).max(axis=1)
    assert np.mean(err <= 1e-5) >= 0.99
    assert err.max() <= 1e-3
    gt = scenario_gt("cardboard", 5000)
    np.testing.assert_array_equal(gt, j_scenario_gt("cardboard", 5000))
    jm = j_evaluate_map(jp, gt)
    tm = evaluate_map(tp, gt, device="cpu")
    assert abs(tm.accuracy_cm - jm.accuracy_cm) <= 1e-3
    assert abs(tm.completeness_cm - jm.completeness_cm) <= 1e-3
    assert tm.accuracy_cm < 2.0                 # 2 cm voxels


def test_reconstruct_close_to_jax_pallas(dataset, tmp_path):
    """Against the Pallas kernels (interpret mode, 8 frames, the kernel's
    default window geometry) the two clouds lie within 1 mm of each other
    in the chamfer sense."""
    from otslam_tpu.core.camera import PinholeIntrinsics as JIntr
    from otslam_tpu.kernels import tsdf_block as jtb
    from otslam_tpu.kernels import tsdf_pallas as jtp
    from otslam_tpu.pipeline import reconstruct as jrec

    frames = range(1, 17, 2)
    jcfg = JRCfg(surface_samples=SAMPLES, camera=JCam(**CAM),
                 tsdf=JTCfg(**VOL))
    batch = JDataset(dataset, jcfg.camera).load_object("Object_0", frames)
    intr = JIntr.from_config(jcfg.camera)
    jcfg = jrec.auto_volume_config(batch, intr, jcfg)
    start = jtb.make_block_volume(jcfg.tsdf)
    vol = jtp.integrate_frames_pallas(
        start, batch.depths, batch.colors, batch.extrinsics, intr,
        max_active=jtp.auto_max_active(start, batch.depths,
                                       batch.extrinsics, intr),
        interpret=True, color_res="full")
    jp = jrec.extract_filtered_cloud(vol, jcfg).points
    tcfg = OTSLAMConfig.from_dict({"reconstruction": dataclasses.asdict(
        JRCfg(surface_samples=SAMPLES, camera=JCam(**CAM),
              tsdf=JTCfg(**VOL)))}).reconstruction
    tres = reconstruct_object(CaptureDataset(dataset, tcfg.camera),
                              "Object_0", tcfg, auto_origin=True,
                              frame_numbers=frames, device="cpu")
    acc, comp = chamfer_metrics(torch.from_numpy(tres.points),
                                torch.from_numpy(np.asarray(jp)))
    assert float(acc) < 1e-3 and float(comp) < 1e-3
