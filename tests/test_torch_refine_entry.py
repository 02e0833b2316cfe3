"""The registration slice's entry points against otslam_tpu (CPU):
evaluate_map(use_icp=True), reconstruct_object / reconstruct_frames with
refine=..., and the CLI's `reconstruct --refine` and `eval --icp`.
"""

import dataclasses
import json

import numpy as np
import pytest

from otslam_tpu.core.camera import PinholeIntrinsics as JIntr
from otslam_tpu.core.se3 import T_FIX_OPTICAL
from otslam_tpu.eval.metrics import evaluate_map as j_evaluate_map
from otslam_tpu.pipeline import refine as jr
from otslam_tpu.pipeline.dataset import CaptureDataset as JDataset
from otslam_tpu.pipeline.reconstruct import reconstruct_object as j_reconstruct
from otslam_tpu_torch.config import OTSLAMConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.eval.metrics import evaluate_map
from otslam_tpu_torch.kernels import nn as tnn
from otslam_tpu_torch.kernels._build import SIGNATURES
from otslam_tpu_torch.pipeline import refine as tr
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.pipeline.reconstruct import (reconstruct_frames,
                                                   reconstruct_object)
from test_refine import CAM, CFG, make_captures, perturb
from torch_parity import lattice_box, small_motion

TCFG = OTSLAMConfig.from_dict(
    {"reconstruction": dataclasses.asdict(CFG)}).reconstruction
J_INTR = JIntr.from_config(CAM)
T_INTR = PinholeIntrinsics.from_config(TCFG.camera)


@pytest.fixture(scope="module")
def drifted():
    depths, colors, gt, _ = make_captures(8)
    return depths, colors, perturb(gt), gt


def test_evaluate_map_with_icp_matches_jax():
    """GT snapped onto a map that is the GT lattice moved by a few mm plus
    outliers: both packages find the same alignment and score it alike."""
    gt, nrm = lattice_box(seed=1)
    T = small_motion()
    rng = np.random.default_rng(6)
    moved = gt.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    moved += rng.normal(0, 0.0003, moved.shape)
    mp = np.concatenate([moved, gt[:400] + 0.15 * nrm[:400]]).astype(
        np.float32)
    jm = j_evaluate_map(mp, gt, use_icp=True)
    tm = evaluate_map(mp, gt, use_icp=True, device="cpu")
    assert abs(tm.accuracy_cm - jm.accuracy_cm) <= 1e-3
    assert abs(tm.completeness_cm - jm.completeness_cm) <= 1e-3
    assert tm.icp_fitness == jm.icp_fitness == 1.0
    np.testing.assert_allclose(tm.icp_rmse, jm.icp_rmse, rtol=1e-5)
    plain = evaluate_map(mp, gt, device="cpu")
    assert tm.completeness_cm < 0.5 * plain.completeness_cm
    # the window routes the GT->map search through the windowed scan
    W, _ = tnn.auto_nn_window(gt, mp, 0.05)
    assert W < -(-len(mp) // tnn.DST_CHUNK)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, drifted):
    """The drifted capture saved by the JAX package's scanner-side
    writer."""
    depths, colors, noisy, _ = drifted
    root = str(tmp_path_factory.mktemp("capture"))
    ds = JDataset(root, CAM)
    for d, c, e in zip(depths, colors, noisy):
        optical = np.linalg.inv(e.astype(np.float64))
        ds.save_frame("Object_0", c.astype(np.uint8), d,
                      optical @ T_FIX_OPTICAL.T)
    return root


def test_reconstruct_object_with_refine_matches_jax(dataset, drifted,
                                                    monkeypatch):
    """reconstruct_object(refine="icp") in both packages: the port's
    refined poses equal the JAX refiner's inside its own reconstruct_object,
    and the two clouds score alike against the box."""
    from otslam_tpu.eval.scenarios import sample_object_surfaces
    _, _, _, gt_ext = drifted
    seen = []

    def jax_refiner(*args, **kw):
        seen.append(refine_trajectory(*args, **kw))
        return seen[-1]
    refine_trajectory = jr.refine_trajectory
    monkeypatch.setattr(jr, "refine_trajectory", jax_refiner)
    jres = j_reconstruct(JDataset(dataset, CAM), "Object_0", CFG,
                         backend="sparse", auto_origin=True, refine="icp")
    tres = reconstruct_object(CaptureDataset(dataset, TCFG.camera),
                              "Object_0", TCFG, auto_origin=True,
                              refine="icp", device="cpu")
    assert len(seen) == 1
    np.testing.assert_allclose(tres.extrinsics, seen[0].extrinsics, rtol=0,
                               atol=1e-4)
    loaded = JDataset(dataset, CAM).load_object("Object_0").extrinsics
    assert (tr.trajectory_error(tres.extrinsics, gt_ext)[0]
            < tr.trajectory_error(loaded, gt_ext)[0])
    assert tres.num_frames == jres.num_frames == 8
    assert abs(tres.raw_surface_count - jres.raw_surface_count) <= \
        1e-3 * jres.raw_surface_count
    box = sample_object_surfaces([make_captures(1)[3]], 20000, seed=0)
    box = box[box[:, 2] >= 0.03]
    jm, tm = j_evaluate_map(jres.points, box), evaluate_map(tres.points, box,
                                                          device="cpu")
    assert abs(tm.accuracy_cm - jm.accuracy_cm) <= 0.02
    assert abs(tm.completeness_cm - jm.completeness_cm) <= 0.02


def test_reconstruct_frames_refine_options(drifted):
    from otslam_tpu_torch.pipeline.dataset import FrameBatch
    depths, colors, noisy, gt = drifted
    batch = FrameBatch(depths, colors, noisy, np.linalg.inv(noisy),
                       [f"Object_0_{i + 1}.jpg" for i in range(8)])
    timings = {}
    res = reconstruct_frames(batch, T_INTR, TCFG, refine="icp",
                             timings=timings, device="cpu")
    assert list(timings) == ["auto_volume", "refine", "fuse", "extract",
                             "trace"]
    assert len(res.points) > 1000 and res.extrinsics.shape == (8, 4, 4)
    assert (tr.trajectory_error(res.extrinsics, gt)[0]
            < tr.trajectory_error(noisy, gt)[0])
    none = reconstruct_frames(batch, T_INTR, TCFG, device="cpu")
    np.testing.assert_array_equal(none.extrinsics, noisy)
    with pytest.raises(ValueError, match="refine"):
        reconstruct_frames(batch, T_INTR, TCFG, refine="slam", device="cpu")


def test_cli_refine_pgo_and_eval_icp_on_the_cpu(dataset, tmp_path):
    """reconstruct --refine pgo and eval --icp run through the CLI on CPU
    tensors: no jax, and no kernel launch."""
    from test_torch_package import CLI, SMALL, report, run_py
    cfg = dict(SMALL)
    cfg["camera"] = cfg["reconstruction"]["camera"] = dict(
        width=CAM.width, height=CAM.height, fx=CAM.fx, fy=CAM.fy, cx=CAM.cx,
        cy=CAM.cy)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    rec = run_py(CLI, "reconstruct", "--dataset", dataset, "--config",
                 str(cfg_path), "--auto-origin", "--refine", "pgo",
                 "--save-dir", str(out), "--device", "cpu")
    assert rec.returncode == 0, rec.stderr
    assert "Object_0: " in rec.stdout and "from 8 frames" in rec.stdout
    r = report(rec)
    assert not r["jax"] and not r["otslam_tpu"]
    assert r["launches"] == [0] * len(SIGNATURES)
    ev = run_py(CLI, "eval", "--map", str(out / "Object_0.ply"),
                "--gt-samples", "5000", "--icp", "--device", "cpu")
    assert ev.returncode == 0, ev.stderr
    metrics = json.loads(ev.stdout.splitlines()[0])
    assert 0 < metrics["accuracy_cm"] < 2.0
    assert 0 < metrics["icp_fitness"] <= 1.0
    r = report(ev)
    assert not r["jax"] and r["launches"] == [0] * len(SIGNATURES)
